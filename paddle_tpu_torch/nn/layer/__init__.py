"""Layer classes (mirrors ``paddle_tpu/nn/layer``)."""
