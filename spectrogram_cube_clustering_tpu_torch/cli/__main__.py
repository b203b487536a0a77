"""`python -m spectrogram_cube_clustering_tpu_torch.cli <init.ini>` ==
run-dc-torch."""

from spectrogram_cube_clustering_tpu_torch.cli.run_dc import main

if __name__ == "__main__":
    main()
