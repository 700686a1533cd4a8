from .metrics import SegEvaluator  # noqa: F401
