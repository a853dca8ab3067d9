from .bn254 import FQ_MOD, FR_MOD, Fp, Fq, Fr  # noqa: F401
from .limbs import LimbField, LIMB_BITS, N_LIMBS, FQ_LIMB, FR_LIMB  # noqa: F401
