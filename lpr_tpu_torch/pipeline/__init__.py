"""The detect -> enhance -> recognize pipeline and string assembly."""
