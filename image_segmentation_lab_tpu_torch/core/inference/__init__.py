from .infer import inference_model, init_model  # noqa: F401
