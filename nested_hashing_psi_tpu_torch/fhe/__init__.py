"""BFV scheme layer (params, packed encoding, BGV core, BFV)."""
