from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .compression import CompressionState, compress_grads, init_compression
from .schedule import cosine_schedule, wsd_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "wsd_schedule",
           "compress_grads", "init_compression", "CompressionState"]
