"""The port's vision backend (CudaBackend) and the VisionState that selects it."""
