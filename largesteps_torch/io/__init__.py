"""Scene construction."""
