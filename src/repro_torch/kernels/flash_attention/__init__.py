"""Flash-attention kernel (see ``ops``)."""
