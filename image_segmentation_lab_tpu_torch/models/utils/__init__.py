from .res_layer import ResLayer  # noqa: F401
