"""Native (C++) components, loaded via ctypes: the Poseidon zktrie
(zktrie_src/zktrie.cpp), built at first use into native/build/."""
