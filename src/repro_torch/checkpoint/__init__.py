"""Atomic checkpoints of array trees and atomic JSON documents (port of
``repro.checkpoint``): suspended filter sessions and the fleet's
control-plane snapshots."""
from repro_torch.checkpoint.store import (all_steps, latest_step,
                                          load_checkpoint, load_json,
                                          save_checkpoint, save_json)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "all_steps",
           "save_json", "load_json"]
