"""Launch helpers of the port: the logical mesh over its one card."""
