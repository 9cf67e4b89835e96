"""CLI: train the KL VAE of UrbanSound8k's log-mel spectrograms with the port.

    python -m xdiffusion_tpu_torch.train_audio_autoencoder \
        --config_path configs/audio/urbansound8k/autoencoder/urbansound8k_4x16x32.yaml \
        --num_training_steps 10000 --batch_size 64

The image VAE-GAN trainer (train_autoencoder.py, the same flags) with
`--dataset_name audio/urbansound8k` as its default, as
training/audio/urbansound8k/train_autoencoder.py sets it. The mels take the
config's `data.image_size`: 32x32, or [frames, n_mels] rectangles (64x128
for urbansound8k_4x16x32.yaml). Writes under
<output_path>/audio_urbansound8k/<config name>/.
"""

from __future__ import annotations

from typing import List, Optional

from xdiffusion_tpu_torch.train_autoencoder import parser, run


def main(argv: Optional[List[str]] = None) -> str:
    args = parser("Train an audio VAE autoencoder (PyTorch port).", 64,
                  "audio/urbansound8k").parse_args(argv)
    from xdiffusion_tpu_torch.training.image.autoencoder import train_autoencoder

    return run(train_autoencoder, args)


if __name__ == "__main__":
    main()
