"""U-Net model and its ops."""
