"""Training substrate of the port's LM stack: AdamW with the global-norm
clip and the warmup-cosine schedule (``optimizer``, also the int8
compressed gradient all-reduce), the synthetic token stream (``data``),
atomic checkpoints (``checkpoint``), and the train, prefill and serve step
builders (``steps``). The port of the JAX package's ``training/``."""
from repro_torch.training.checkpoint import (latest_checkpoint, load_pytree,
                                             save_pytree)
from repro_torch.training.data import synthetic_batches
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update,
                                            clip_by_global_norm, lr_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "lr_schedule", "latest_checkpoint", "load_pytree", "save_pytree",
           "synthetic_batches"]
