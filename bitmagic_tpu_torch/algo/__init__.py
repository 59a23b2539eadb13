"""Free functions over bit-vectors."""
