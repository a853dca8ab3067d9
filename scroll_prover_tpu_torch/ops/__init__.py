"""Device ops: limb-plane field arithmetic, NTT, EC, MSM, fixed-base
multiplication — plain PyTorch versions plus the CUDA kernels' wrappers."""
