"""Cross-shard helpers of the port (`distributed.collectives`)."""
