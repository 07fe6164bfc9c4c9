"""nomad_tpu_torch.obs — span-based eval tracing (a copy of
nomad_tpu/obs/trace.py). The device-runtime telemetry module is not
ported yet."""
from . import trace                                    # noqa: F401
from .trace import (                                   # noqa: F401
    NOOP_SPAN, Span, SpanCtx, Tracer, chain_summary, chrome_trace, tracer,
)

__all__ = ["trace", "tracer", "Tracer", "Span", "SpanCtx", "NOOP_SPAN",
           "chrome_trace", "chain_summary"]
