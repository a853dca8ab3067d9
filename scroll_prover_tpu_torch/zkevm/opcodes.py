"""EVM opcode mnemonic -> byte map (Shanghai/Curie set as traced by l2geth).

Used by the evm subcircuit's bytecode lookup: each executed step's opcode
byte must equal the byte at (code_hash, pc) in the bytecode table
(reference zkevm-circuits evm<->bytecode lookup, SURVEY.md L3a)."""

OPCODE_BYTE: dict[str, int] = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "SDIV": 0x05, "MOD": 0x06, "SMOD": 0x07, "ADDMOD": 0x08, "MULMOD": 0x09,
    "EXP": 0x0A, "SIGNEXTEND": 0x0B,
    "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13, "EQ": 0x14,
    "ISZERO": 0x15, "AND": 0x16, "OR": 0x17, "XOR": 0x18, "NOT": 0x19,
    "BYTE": 0x1A, "SHL": 0x1B, "SHR": 0x1C, "SAR": 0x1D,
    "SHA3": 0x20, "KECCAK256": 0x20,
    "ADDRESS": 0x30, "BALANCE": 0x31, "ORIGIN": 0x32, "CALLER": 0x33,
    "CALLVALUE": 0x34, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "CALLDATACOPY": 0x37, "CODESIZE": 0x38, "CODECOPY": 0x39,
    "GASPRICE": 0x3A, "EXTCODESIZE": 0x3B, "EXTCODECOPY": 0x3C,
    "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E, "EXTCODEHASH": 0x3F,
    "BLOCKHASH": 0x40, "COINBASE": 0x41, "TIMESTAMP": 0x42, "NUMBER": 0x43,
    "DIFFICULTY": 0x44, "PREVRANDAO": 0x44, "GASLIMIT": 0x45,
    "CHAINID": 0x46, "SELFBALANCE": 0x47, "BASEFEE": 0x48,
    "BLOBHASH": 0x49, "BLOBBASEFEE": 0x4A,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57,
    "PC": 0x58, "MSIZE": 0x59, "GAS": 0x5A, "JUMPDEST": 0x5B,
    "TLOAD": 0x5C, "TSTORE": 0x5D, "MCOPY": 0x5E,
    "PUSH0": 0x5F,
    **{f"PUSH{i}": 0x5F + i for i in range(1, 33)},
    **{f"DUP{i}": 0x7F + i for i in range(1, 17)},
    **{f"SWAP{i}": 0x8F + i for i in range(1, 17)},
    "LOG0": 0xA0, "LOG1": 0xA1, "LOG2": 0xA2, "LOG3": 0xA3, "LOG4": 0xA4,
    "CREATE": 0xF0, "CALL": 0xF1, "CALLCODE": 0xF2, "RETURN": 0xF3,
    "DELEGATECALL": 0xF4, "CREATE2": 0xF5, "STATICCALL": 0xFA,
    "REVERT": 0xFD, "INVALID": 0xFE, "SELFDESTRUCT": 0xFF,
}


def opcode_byte(op: str) -> int:
    """Byte for a traced mnemonic; -1 when unknown (step excluded from the
    bytecode lookup rather than silently mis-bound)."""
    return OPCODE_BYTE.get(op, -1)
