"""Steps over the model: the serve step so far (the train step comes with
the training slice)."""

from .train_step import make_serve_step

__all__ = ["make_serve_step"]
