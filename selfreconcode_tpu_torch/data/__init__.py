"""Scene dataset and PNG codec."""
