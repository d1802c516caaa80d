"""Pipeline configuration, the eval render pipeline and the frame renderer."""
