"""Checkpoints of the port: atomic step directories."""
from .checkpoint import (all_steps, latest_step, restore_checkpoint,
                         save_checkpoint)

__all__ = ["all_steps", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
