"""The fused stage-graph pipeline: registry (`stages`), compiler and
entries (`graph`), the biosignal graph (`kernel`), the ASR front-end
graph (`asr`), the build and binding of every CUDA kernel of the port
(`cuda`; the graph kernels' sources in `csrc/`), the staged biosignal
baselines (`ref`) and the public API (`ops`)."""
