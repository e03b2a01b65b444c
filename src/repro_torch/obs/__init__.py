"""Observability: the span recorder the engine's filter/refine spans use."""

from .trace import (NULL_RECORDER, NullRecorder, Span,  # noqa: F401
                    TraceRecorder, child_complete, child_span, current)
