"""The yardstick's arithmetic: work counted by the benchmark's own walk,
operations, bytes, busy time and syncs."""
