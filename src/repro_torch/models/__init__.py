"""Models on torch: the SSM protocol layer and the tracking application."""
