"""Video file decode and encode through OpenCV, imported only when called."""
