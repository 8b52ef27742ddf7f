"""Serving subsystem (port of `repro.core.serving`): paged KV cache,
continuous batching, prefix cache, and the multi-replica admission router.

The unit of planning here is a *request stream*, not a train step, but the
architecture is the same plan-centric one the training side uses: a frozen
``ServePlan`` (the serving analogue of ``ParallelPlan``) is resolved ONCE
from the hw.py roofline and the cache-arena budget, and every runtime
decision — page allocation, slot assignment, chunked-prefill interleaving,
eviction, routing — executes that plan.

  pages.py      fixed-size KV pages in a pooled arena (+ the in-place
                gather/scatter the models call), page tables, host PagePool
  scheduler.py  ServePlan + the continuous-batching scheduler
  prefix.py     prefix caching via page-table sharing on full pages
  router.py     multi-replica admission router + latency projection
"""

from repro_torch.core.serving.pages import (PagePool, arena_abstract,
                                            dense_to_pages, gather_tokens,
                                            scatter_tokens)
from repro_torch.core.serving.prefix import PrefixCache
from repro_torch.core.serving.scheduler import (ContinuousBatcher, Request,
                                                ServePlan, plan_serve,
                                                run_virtual, static_schedule)
from repro_torch.core.serving.router import (Router, simulate_trace,
                                             synthetic_trace)

__all__ = [
    "PagePool", "arena_abstract", "dense_to_pages", "gather_tokens",
    "scatter_tokens", "PrefixCache", "ContinuousBatcher", "Request",
    "ServePlan", "plan_serve", "run_virtual", "static_schedule",
    "Router", "simulate_trace", "synthetic_trace",
]
