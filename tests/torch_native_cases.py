"""The native libraries both packages load through ctypes, built once per
tree before any test compares results through them.

Each package builds its zstd codec and its zktrie at first use. The JAX
package runs `make` in place (scroll_prover_tpu/native/zstd_codec.py and
trie/zktrie.py `_load`), so parallel test workers that reach a missing
library at once can find it half written: `ctypes.CDLL` fails, the loader
marks the codec unavailable for the rest of that process, and the two
packages then build different blob envelopes. Importing this module takes
an exclusive lock on a file in the port's git-ignored native/build/, calls
the JAX package's two loaders and then the port's two under it, and
releases it: one process builds each library, the others wait and load
the finished file. Import it before anything that calls a loader: the
first port test file every worker collects (test_torch_aggregation_circuit.py)
and every port test file that compares results through a native library.
Nothing of either package changes; each builds its own library."""
from __future__ import annotations

import fcntl
import os

from scroll_prover_tpu.native import zstd_codec as jax_zstd
from scroll_prover_tpu.trie import zktrie as jax_zktrie
from scroll_prover_tpu_torch.native import zstd_codec as torch_zstd
from scroll_prover_tpu_torch.trie import zktrie as torch_zktrie

LOCK = os.path.join(os.path.dirname(torch_zstd.__file__), "build", "native_libs.lock")


def _load_all() -> dict[str, bool]:
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            return {
                "jax zstd": jax_zstd.zstd_available(),
                "jax zktrie": jax_zktrie.native_available(),
                "torch zstd": torch_zstd.zstd_available(),
                "torch zktrie": torch_zktrie.native_available(),
            }
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


AVAILABLE = _load_all()
