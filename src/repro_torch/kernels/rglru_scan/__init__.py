"""Linear-recurrence (RG-LRU) scan kernel (see ``ops``)."""
