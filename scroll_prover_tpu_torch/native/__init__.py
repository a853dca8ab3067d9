"""Native (C++) components, loaded via ctypes: the Poseidon zktrie
(zktrie_src/zktrie.cpp) and the pinned-parameter zstd codec
(zstd_src/zstd_codec.cpp, over the system libzstd), each built at first use
into native/build/."""
