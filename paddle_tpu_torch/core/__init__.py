"""Device, dtype and random-number plumbing (mirrors ``paddle_tpu.core``)."""
