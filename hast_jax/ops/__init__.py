"""Device kernels: k-mer codec, membership table, sort-based counting."""

from hast_jax.ops import encode, hashtable, kmer_count  # noqa: F401
