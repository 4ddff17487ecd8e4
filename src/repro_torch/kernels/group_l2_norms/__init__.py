"""Group sum-of-squares kernel (see ``ops``)."""
