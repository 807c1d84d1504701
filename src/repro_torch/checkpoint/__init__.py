from .checkpointer import Checkpointer, CheckpointSpec, latest_step

__all__ = ["Checkpointer", "CheckpointSpec", "latest_step"]
