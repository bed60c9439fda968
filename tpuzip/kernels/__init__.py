"""Hand-written device kernels.

`ari_cuda`: the ari range coder as a CUDA kernel called through `jax.ffi`
(one stream per thread or per warp), byte-identical to the host C++ coder.
Every other device stage is plain XLA in tpuzip.codecs; the backend table
(tpuzip.dist.backend) says which implementation serves each stage.
"""
