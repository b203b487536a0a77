"""Input generators: waveforms, catalog events and the serving request mix."""
