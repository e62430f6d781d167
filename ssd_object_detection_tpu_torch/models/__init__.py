"""The SSD networks: VGG-16 trunk, extra pyramid and loc/conf heads."""
