"""The synthetic worlds and laps the cells' frames are rendered from."""
