"""nomad_tpu.obs — observability subsystem (ISSUES 7, 11): span-based
eval tracing with fan-in links, a bounded in-memory trace store, a
Chrome trace-event / Perfetto exporter, and device-runtime telemetry
(per-device memory watermarks, compile-cache counters, mesh layout).
See docs/OBSERVABILITY.md."""
from . import devruntime, trace                        # noqa: F401
from .trace import (                                   # noqa: F401
    NOOP_SPAN, Span, SpanCtx, Tracer, chain_summary, chrome_trace, tracer,
)

__all__ = ["trace", "tracer", "Tracer", "Span", "SpanCtx", "NOOP_SPAN",
           "chrome_trace", "chain_summary", "devruntime"]
