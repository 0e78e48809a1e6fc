"""Command-line entry points (`python -m seismic_tpu_torch.cli.<name>`),
with the flags of the JAX package's `seismic_tpu/cli/` and `--device`
where a device runs (the card by default; `--device cpu` runs the plain
versions of the kernels):

- `convert_json_to_inner_format`: JSONL / tar.gz -> the inner binary
  format and its side files;
- `build_inverted_index` / `perf_inverted_index`: build an index from a
  `.bin` file and time batched queries over it (the grouped route on the
  card for exhaustive-list requests, the engine path otherwise);
- `build_enhanced_inverted_index` / `perf_enhanced_inverted_index`: the
  same through `SeismicIndex` on JSONL (string tokens).
"""
