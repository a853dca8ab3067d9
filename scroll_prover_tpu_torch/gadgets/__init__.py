"""In-circuit gadgets over the Fr circuit: the shared-column Builder, the
non-native big-int chip, curve arithmetic over non-native fields and ECDSA
verification, as the super circuit's sig, ecc and modexp subcircuits use
them."""
