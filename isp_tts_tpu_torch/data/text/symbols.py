"""Service tokens and charset macros (from ``isp_tts_tpu/data/text/symbols.py``)."""

PAD = "<pad>"
EOS = "</s>"

PUNCTUATION = ".!?():;,—- '\""
MARKS = "+*\\"

RUSSIAN = "абвгдеёжзийклмнопрстуфхцчшщъыьэюя"
ENGLISH = "abcdefghijklmnopqrstuvwxyz"

IPA_PHONEMES = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ̃'"
)

CHARSET_MAP = {
    "#punct": PUNCTUATION,
    "#marks": MARKS,
    "#ru": RUSSIAN,
    "#en": ENGLISH,
    "#ipa_ph": IPA_PHONEMES,
}
