from .encoder_decoder import EncoderDecoder  # noqa: F401
