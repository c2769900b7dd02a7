"""Training data of the port: video-folder and packed datasets, loader."""
