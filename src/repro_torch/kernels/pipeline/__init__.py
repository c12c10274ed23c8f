"""The fused stage-graph pipeline: registry (`stages`), compiler and
entries (`graph`), the biosignal graph (`kernel`), its CUDA binding
(`cuda`, source in `csrc/`) and the public API (`ops`)."""
