"""scroll_prover_tpu_torch — the PyTorch/CUDA port of scroll_prover_tpu.

The same PLONK-KZG prover over BN254, mirroring the JAX package's layout
(fields/, ops/, curves/, hashes/, proof_system/, proof_system/plonk/), with
each Pallas kernel of the main path rewritten as a CUDA C++ kernel for Hopper
(sm_90a) under csrc/. It imports torch and numpy, never jax or the JAX
package. Entry points run on the card unless called with device="cpu".
"""

__version__ = "0.1.0"
