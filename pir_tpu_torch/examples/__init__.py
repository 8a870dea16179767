"""Runnable demos of pir_tpu_torch: ``python3 -m pir_tpu_torch.examples.<name>``."""
