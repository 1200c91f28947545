"""The LM stack of the port: ``config`` (the JAX package's dataclasses),
``layers`` (norms, rotary embeddings, MLPs, GQA attention, MLA), ``moe``
(the MoE layer: capacity dispatch, shared experts, the aux-free bias) and
``model`` (``init_model``, ``forward``, ``prefill``, ``decode_step``,
``mtp_logits``)."""
