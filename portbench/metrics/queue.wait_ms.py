"""queue.wait_ms (ms): the mean wait of an admitted request in the
serving engine's admission queue, from its ``submit()`` (or a
preemption's requeue) to the start of its admission: the engine's
counters over the window (``queue_wait_s / prefills``).  The first of
the three parts of a time to first token, before the prefill and the
decode that the admitting step runs.  A request still queued when the
window closes adds nothing, so under a backlog the mean reads low.
Moves ``ttft_p50_ms``."""


def read(run):
    wait, admits = run.stats.get("queue_wait_s"), run.stats["prefills"]
    return 1e3 * wait / admits if wait is not None and admits else None
