"""hast_jax — a JAX trio-binning framework.

A from-scratch re-design of the capabilities of BGI-Qingdao/HAST
(haplotype-resolved assembly via trio binning of stLFR linked reads)
for an accelerator: JAX/XLA for the compute path (canonical k-mer
extraction, hash-table probing, k-mer counting, vote reduction over
device meshes) and native/host code for the IO path.

Layer map (mirrors reference /root/reference per SURVEY.md):
  ops/       k-mer codec, hash tables, counting, probe kernels  (L0a analog)
  pipeline/  stage 00 markers, stage 01 classify, stage 02 10X
             conversion, stage 03 re-phasing                    (L1-L4)
  parallel/  mesh / sharded tables / distributed merge          (scale-out)
  io/        fastq/fasta streaming, gz decode                   (L0b/L0c)
  models/    end-to-end "model" objects: trio binning engine,
             segment phaser, Hi-C classifier
  utils/     bounds finder, logging, step checkpoints
  tools/     validation & QC (VCF phasing QC, heat-align SVG)
"""

__version__ = "0.1.0"
