"""repro_torch.data: corpora, sequence packing and device prefetch
(twin of ``repro/data/``)."""
