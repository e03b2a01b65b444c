"""Launch helpers of the port: the placement devices (`mesh`)."""
