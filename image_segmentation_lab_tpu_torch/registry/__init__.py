from .register import Register  # noqa: F401
