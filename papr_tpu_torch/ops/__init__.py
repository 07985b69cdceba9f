"""Selection, embedder and attention ops with their CUDA kernels (counterparts of ``papr_tpu/ops``)."""
