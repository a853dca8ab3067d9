"""The benchmark's plain reference: BN254 arithmetic on Python integers,
Keccak-256, and the checks that decide a run's `correct`.

It imports neither JAX, nor the JAX package, nor anything of the port
(`scroll_prover_tpu_torch`): it reads the port's outputs only to judge
them, and works out again everything it compares them with, from the
inputs the benchmark made (the seed, the traces, the SRS's tau).
"""
