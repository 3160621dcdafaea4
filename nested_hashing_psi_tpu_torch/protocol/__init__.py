"""Protocol client/server pairs and runners."""
