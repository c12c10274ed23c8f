"""Model layers of the port. So far `attention` holds the O(S^2) oracle
that the flash-attention kernel is held to; the LM slice extends it."""
