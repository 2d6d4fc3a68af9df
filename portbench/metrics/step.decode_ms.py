"""step.decode_ms (ms): the model's decode step as the window saw it,
the mean host wall of the window's ``step()`` calls that admitted
nothing (the engine's ``prefills`` counter did not move) and decoded.
Moves ``itl_p95_ms``."""
from portbench.harness import measure


def read(run):
    return measure.decode_step_ms(run)
