"""Traffic kinds: one module each, found by the name a cell gives."""
