"""AR decode operations: weight packing, draft block, verify, sampling."""
