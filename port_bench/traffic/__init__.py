"""Traffic mixes: the sampling arithmetic that derives them and the feed
that turns them into task dicts."""
