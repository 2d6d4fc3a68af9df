"""mlp_chain_roofline.reasoning (%): ``mlp_chain_roofline`` in the
closed-loop reasoning cell, where nearly every traced step is a decode
step at a full batch (M = 32 live rows).  Moves ``out_tok_s``."""
from portbench.harness import spec

read = spec.reader("mlp_chain_roofline")
