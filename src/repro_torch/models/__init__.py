"""Models on torch: the SSM protocol layer, the tracking application
and the language-model stack (``models.lm``)."""
