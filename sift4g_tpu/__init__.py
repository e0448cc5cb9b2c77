"""sift4g_tpu — a SIFT4G engine in JAX / XLA / Pallas for NVIDIA GPUs.

A from-scratch re-design of the capabilities of rvaser/sift4g:

* k-mer prefilter over a streamed FASTA database (host CSR hash + native C++
  hot loop; device batch LIS scoring),
* batched affine-gap alignment scores (SW/NW/HW/OV) — a Pallas-Triton GPU
  kernel with one lane per database target,
* Karlin-Altschul E-value filtering,
* median-entropy alignment selection and SIFT (Dirichlet-mixture PSSM)
  scoring as vectorized array ops,
* multi-device scaling via jax.sharding.Mesh + shard_map (group-sharded
  launches, per-shard top-k and collective merges).
"""

__version__ = "0.1.0"
