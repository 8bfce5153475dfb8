"""The benchmark's plain reference: frozen copies of the port's host
modules (config, two-bit codes, genome, the seed index's monolithic
build, the per-read oracle, the vectorized host caller that is held bit
for bit equal to it, the aggregator and the BED writer), with their
imports pointed here and the native search left out. Nothing in this
package imports the program under test (`find_circ2_tpu_torch`) or the
JAX package; `compare.py` is its entry."""
