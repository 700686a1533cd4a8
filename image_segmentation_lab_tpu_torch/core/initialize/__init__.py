from .checkpoint import load_checkpoint  # noqa: F401
from .init_functions import init_weights  # noqa: F401
