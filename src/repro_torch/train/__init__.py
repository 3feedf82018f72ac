"""Training on torch (port of ``repro.train``)."""
from repro_torch.train.step import (TrainConfig, chunked_xent,
                                    make_serve_step, make_train_step)

__all__ = ["TrainConfig", "chunked_xent", "make_train_step",
           "make_serve_step"]
