from . import synth  # noqa: F401
