"""repro_torch — the PyTorch/CUDA port of the DRONE/SVHM subgraph-centric
graph engine, beside the JAX package ``repro`` that it is held against.

The port's main path is ``repro_torch.session.GraphSession``:
``GraphSession.from_graph(g, P).query(program, params)`` for SSSP,
ConnectedComponents and PageRank on the simulator backend, with the local
sweep's semiring product on ``edge_backend`` ``"coo"`` (PyTorch scatter),
``"pallas_tiles"`` (the hand-written CUDA ``bsp_spmv`` kernel) or
``"pallas_windows"`` (the hand-written CUDA ``segment_combine`` kernel).
The backend names are kept from the reference so configurations carry
across unchanged.

The LM stack is ported too: ``repro_torch.configs`` (the reference's
architecture registry), ``repro_torch.models`` (every arch's blocks,
``forward``, ``prefill`` and ``decode_step`` with its caches),
``repro_torch.training`` (the train, prefill and greedy serve steps,
AdamW, the synthetic token stream, checkpoints) and
``repro_torch.launch.train`` (the training driver with checkpoint and
restart).

Every entry point takes ``device=None``, which means the first CUDA card;
on a machine without one it raises unless the caller passes
``device="cpu"`` (where the kernels' plain PyTorch versions run).
"""

__version__ = "0.1.0"
