"""PyTorch ops: encoding, sampling, compositing, rays, rendering and the
fused MLP kernel."""
