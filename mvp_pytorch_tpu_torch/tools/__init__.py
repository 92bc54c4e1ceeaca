"""Command-line tools of the port: region-feature extraction and its image
transforms."""
