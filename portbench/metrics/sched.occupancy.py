"""sched.occupancy (%): the serving engine's share of decode slots that
held a request, its own counters over the window's steps
(``active_steps / slot_steps``).  Moves ``out_tok_s``."""


def read(run):
    slots = run.stats.get("slot_steps", 0)
    return 100.0 * run.stats["active_steps"] / slots if slots else None
