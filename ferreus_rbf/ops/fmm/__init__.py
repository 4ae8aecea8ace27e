"""Black-box FMM engine: level-batched padded-octree BBFMM.

Redesign of ``ferreus_bbfmm`` (Fong & Darve 2009 black-box FMM with the
Messner et al. 2012 symmetry-optimised M2L): the hashmap/pointer tree of the
reference becomes dense per-level index arrays built once on the host, and
every pass is a batched matmul/einsum on the device.
"""
