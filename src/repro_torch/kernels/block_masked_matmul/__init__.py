"""Block-masked matmul kernel (see ``ops``)."""
