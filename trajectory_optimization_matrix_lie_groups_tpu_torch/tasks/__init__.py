"""Problems of the port and their committed goldens."""
