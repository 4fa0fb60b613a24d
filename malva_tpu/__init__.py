"""malva_tpu — an alignment-free genotyper on JAX.

A from-scratch JAX/XLA re-design of the capabilities of AlgoLab/malva
(reference: /root/reference, surveyed in SURVEY.md): given a reference genome
(FASTA), a population VCF of known variants, and a sample of sequencing reads,
it emits a single-sample VCF with GT:GQ calls, bit-identically to the
reference pipeline (`malva-geno index` + `call` fed by KMC), while running the
hot paths (k-mer hashing, Bloom-filter probes, coverage accumulation) as
vectorized device programs on a GPU.

Top-level layout:
  ops/      device kernels + exact host mirrors (XXH3, canonicalization,
            Bloom probes/scatter, k-mer packing)
  io/       FASTA/FASTQ/VCF host I/O
  variants/ variant model + haplotype-aware signature extraction
  index/    Bloom filter + exact k-mer map index (build/serialize)
  count/    streaming sample k-mer counting (KMC replacement)
  models/   genotype-likelihood model (GT/GQ posterior)
  parallel/ device mesh, sharded query/coverage-merge steps
  utils/    config, phase timing
"""

__version__ = "0.1.0"
