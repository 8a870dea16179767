"""Serving on several ranks over ``torch.distributed`` (port of
``pir_tpu/parallel``): the db, batch and limb mesh axes."""
