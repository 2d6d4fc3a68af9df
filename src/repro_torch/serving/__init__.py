"""Continuous-batching serving over a paged KV cache."""
from .engine import FinishedRequest, OUTCOMES, ServingEngine  # noqa: F401
from .kv_pages import PagePool, RequestPages  # noqa: F401
