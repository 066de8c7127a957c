"""I/O codecs: FASTA / PHYLIP / JSON with reference-identical byte formats."""

from coati_tpu_torch.io.iodispatch import read_input, write_output, extract_file_type

__all__ = ["read_input", "write_output", "extract_file_type"]
