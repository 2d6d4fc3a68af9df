"""PyTorch/CUDA port of the MCFuser system, beside the JAX package
``repro`` (the reference).  It imports torch and never jax or repro."""
