"""device.idle_share (%): the share of the traced stretch in which no
operation ran on the card (``torch.profiler``).  Moves ``out_tok_s``."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
