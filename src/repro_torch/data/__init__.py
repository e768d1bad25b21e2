# Data pipeline: compressed token shards decompressed on the card.
