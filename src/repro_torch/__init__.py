"""CODAG decode path on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of the JAX package ``repro``: the same chunked container
format, host encoders and ``DecodePlan`` pipeline, with the decode kernels
written in CUDA C++ for ``sm_90a`` (``csrc/``).  Module names mirror
``repro`` so each piece has an obvious reference.

    from repro_torch.core import api
    cas = api.compress_many(arrays, "rle_v2")
    outs = api.decompress_many(cas, device_out=True)      # torch tensors on cuda
"""
