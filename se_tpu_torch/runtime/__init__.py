"""Host-side native code of the port: the wav reader (`native`)."""
