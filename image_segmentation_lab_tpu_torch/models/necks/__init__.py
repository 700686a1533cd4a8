from .featurepyramid import Feature2Pyramid  # noqa: F401
