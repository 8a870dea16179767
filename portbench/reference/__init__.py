"""A frozen copy of pir_tpu_torch's client path, in plain PyTorch and numpy: it
makes the benchmark's requests and judges every reply.  It imports nothing
of the program."""
