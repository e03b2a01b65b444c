from . import loader, synth  # noqa: F401
