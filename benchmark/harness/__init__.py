"""The benchmark's general code: it finds cells, configurations, entries,
metric readers and kernel counts by name and runs them. Nothing here
imports JAX or the JAX package."""
