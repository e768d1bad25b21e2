# Fault-tolerant checkpointing: atomic, async, codec-compressed.
