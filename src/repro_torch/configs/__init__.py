from .base import ARCHS, SHAPES, get_config, get_smoke_config, input_specs, applicable  # noqa
