"""step.decode_ms.chat (ms): ``step.decode_ms`` in an open-loop cell,
the mean host wall of the window's ``step()`` calls that admitted
nothing and decoded.  Moves ``chat_itl_p50_ms``."""
from portbench.harness import measure


def read(run):
    return measure.decode_step_ms(run)
