"""Multi-device samplers of the port: chains over ranks with the full
single-device engine per rank (:mod:`.data_parallel`), and the
lattice-decomposed MGMC cycle with explicit halos (:mod:`.cycle`), over NCCL
on CUDA devices and gloo on the CPU (:mod:`.mesh`, :mod:`.halo`; the dry run
and the launcher of rank worlds: :mod:`.dryrun`)."""
