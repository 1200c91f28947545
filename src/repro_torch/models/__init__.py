"""The LM stack of the port: ``config`` (the JAX package's dataclasses),
``layers`` (norms, rotary embeddings, MLPs, GQA attention) and ``model``
(``init_model``, ``forward``, ``prefill``, ``decode_step``) for dense and
GQA attention blocks."""
